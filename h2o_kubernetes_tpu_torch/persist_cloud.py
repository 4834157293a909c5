"""Cloud persist backends: s3://, gs://, hdfs:// for PERSIST_SCHEMES.

The same verbs as the local file system (save_model/load_model,
export_file, the model registry and the durable pool store) on cloud
object stores, spoken over the stores' REST protocols with the
standard library — no SDK import is required, so a pod image needs
nothing extra. The code is the JAX package's ``persist_cloud.py``;
signing, retries and error mapping are the same:

- s3://bucket/key — AWS Signature V4 over HTTPS. Credentials from the
  standard env (AWS_ACCESS_KEY_ID / AWS_SECRET_ACCESS_KEY /
  AWS_SESSION_TOKEN, region from AWS_REGION); unsigned anonymous
  requests when no credentials are set (public buckets, fakes).
  Endpoint override: AWS_ENDPOINT_URL (path-style addressing — the
  convention minio/localstack/moto use).
- gs://bucket/key — GCS JSON API (storage/v1). Bearer token from
  GOOGLE_OAUTH_ACCESS_TOKEN when set, else anonymous. Endpoint
  override: STORAGE_EMULATOR_HOST (the official GCS emulator env).
- hdfs://path — WebHDFS (OPEN / CREATE with the two-step redirect
  dance). Namenode from H2O_TPU_WEBHDFS (e.g. http://namenode:9870);
  the hdfs:// path maps to /webhdfs/v1<path>.

All three register in persist.PERSIST_SCHEMES at import (persist.py
imports this module), exactly like a PersistManager provider.
"""

from __future__ import annotations

import hashlib
import hmac
import http.client
import os
import urllib.error
import urllib.parse
import urllib.request
from datetime import datetime, timezone

__all__ = ["s3_read", "s3_write", "gs_read", "gs_write",
           "hdfs_read", "hdfs_write"]


def _retry_after(e: urllib.error.HTTPError) -> float | None:
    """Seconds from a Retry-After header (numeric form only — the
    HTTP-date form is rare on object stores and not worth a parser)."""
    try:
        raw = e.headers.get("Retry-After") if e.headers else None
        return float(raw) if raw else None
    except (TypeError, ValueError):
        return None


def _http(method: str, url: str, data: bytes | None = None,
          headers=None, timeout: float = 60.0,
          read: bool | None = None, policy=None) -> bytes:
    """One HTTP verb with the shared retry/backoff policy.

    Transients — 429, 5xx (honoring Retry-After), timeouts, connection
    resets, truncated transfers — retry under H2O_TPU_RETRY_* knobs, so
    an S3/GCS/WebHDFS blip no longer destroys a model save or an AutoML
    checkpoint. `read` marks the verb as a data fetch: ONLY reads map
    HTTP 404 to FileNotFoundError (callers like the resume manifest
    probe for "not there yet"); a 404 on a write (a WebHDFS CREATE
    redirect target or a deleted GCS upload session) is an IOError —
    the object is not "missing", the write path is broken.

    `headers` may be a dict or a zero-arg callable re-evaluated per
    attempt: SigV4 signatures (x-amz-date, 15-min validity) and OAuth
    bearer tokens must be FRESH on each retry, or a long outage ridden
    out under a raised H2O_TPU_RETRY_DEADLINE ends in a permanent 403
    once the first attempt's signature goes stale.
    """
    if read is None:
        read = method == "GET"
    from .runtime import faults, retry

    def attempt() -> bytes:
        hdrs = headers() if callable(headers) else (headers or {})
        req = urllib.request.Request(url, data=data, method=method,
                                     headers=hdrs)
        try:
            # the fault point sits INSIDE the classifier so injected
            # errors (real HTTPError/URLError/... instances) take the
            # exact retry/permanent path their real twins would
            faults.fire("persist.http", method=method, url=url)
            with urllib.request.urlopen(req, timeout=timeout) as r:  # noqa: S310
                return r.read()
        except urllib.error.HTTPError as e:
            body = e.read()[:300].decode(errors="replace")
            if e.code == 404:
                if read:
                    raise FileNotFoundError(
                        f"{method} {url} -> HTTP 404") from None
                raise IOError(f"{method} {url} -> HTTP 404 "
                              "(write target gone)") from None
            if e.code == 429 or e.code >= 500:
                raise retry.TransientError(
                    f"{method} {url} -> HTTP {e.code}: {body}",
                    retry_after=_retry_after(e)) from None
            raise IOError(
                f"{method} {url} -> HTTP {e.code}: {body}") from None
        except http.client.IncompleteRead as e:
            raise retry.TransientError(
                f"{method} {url} -> truncated transfer: {e!r}") from None
        except (TimeoutError, ConnectionError) as e:
            raise retry.TransientError(
                f"{method} {url} -> {e!r}") from None
        except urllib.error.URLError as e:
            raise retry.TransientError(
                f"{method} {url} -> {e.reason!r}") from None

    return retry.call(attempt, policy=policy, describe=f"{method} {url}")


# -- s3:// -------------------------------------------------------------------

def _split_bucket_key(path: str) -> tuple[str, str]:
    scheme, _, rest = path.partition("://")
    if "/" not in rest:
        raise ValueError(f"{path}: expected {scheme}://bucket/key")
    bucket, key = rest.split("/", 1)
    if not bucket or not key:
        raise ValueError(f"{path}: expected {scheme}://bucket/key")
    return bucket, key


def _s3_url(bucket: str, key: str) -> tuple[str, str, str]:
    """(url, host, canonical_uri) with path-style for custom endpoints."""
    key_enc = urllib.parse.quote(key, safe="/~-._")
    endpoint = os.environ.get("AWS_ENDPOINT_URL")
    if endpoint:
        endpoint = endpoint.rstrip("/")
        parsed = urllib.parse.urlparse(endpoint)
        # the endpoint may be mounted under a subpath (gateway:9000/minio)
        # — the signature must cover the path the server actually sees
        base_path = parsed.path.rstrip("/")
        return (f"{endpoint}/{bucket}/{key_enc}", parsed.netloc,
                f"{base_path}/{bucket}/{key_enc}")
    region = os.environ.get("AWS_REGION",
                            os.environ.get("AWS_DEFAULT_REGION",
                                           "us-east-1"))
    host = f"{bucket}.s3.{region}.amazonaws.com"
    return f"https://{host}/{key_enc}", host, f"/{key_enc}"


def _sigv4_headers(method: str, host: str, canonical_uri: str,
                   payload: bytes) -> dict:
    """AWS Signature V4 (the exact algorithm PersistS3's SDK applies);
    returns {} when no credentials are in the env (anonymous)."""
    akid = os.environ.get("AWS_ACCESS_KEY_ID")
    secret = os.environ.get("AWS_SECRET_ACCESS_KEY")
    payload_hash = hashlib.sha256(payload).hexdigest()
    if bool(akid) != bool(secret):
        # half-configured credentials (e.g. a failed secret mount) must
        # not silently degrade to anonymous — the resulting 403 would
        # point at bucket policy instead of the real misconfiguration
        raise ValueError(
            "AWS credentials half-configured: set BOTH "
            "AWS_ACCESS_KEY_ID and AWS_SECRET_ACCESS_KEY (or neither "
            "for anonymous access)")
    if not akid:
        return {"x-amz-content-sha256": payload_hash}
    region = os.environ.get("AWS_REGION",
                            os.environ.get("AWS_DEFAULT_REGION",
                                           "us-east-1"))
    now = datetime.now(timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")
    token = os.environ.get("AWS_SESSION_TOKEN")
    headers = {"host": host, "x-amz-content-sha256": payload_hash,
               "x-amz-date": amz_date}
    if token:
        headers["x-amz-security-token"] = token
    signed = ";".join(sorted(headers))
    canonical = "\n".join([
        method, canonical_uri, "",
        "".join(f"{k}:{headers[k]}\n" for k in sorted(headers)),
        signed, payload_hash])
    scope = f"{datestamp}/{region}/s3/aws4_request"
    to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        hashlib.sha256(canonical.encode()).hexdigest()])

    def _hm(key: bytes, msg: str) -> bytes:
        return hmac.new(key, msg.encode(), hashlib.sha256).digest()

    k = _hm(_hm(_hm(_hm(b"AWS4" + secret.encode(), datestamp),
                    region), "s3"), "aws4_request")
    sig = hmac.new(k, to_sign.encode(), hashlib.sha256).hexdigest()
    out = dict(headers)
    del out["host"]          # urllib sets Host itself
    out["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={akid}/{scope}, "
        f"SignedHeaders={signed}, Signature={sig}")
    return out


def s3_read(path: str) -> bytes:
    bucket, key = _split_bucket_key(path)
    url, host, uri = _s3_url(bucket, key)
    return _http("GET", url,
                 headers=lambda: _sigv4_headers("GET", host, uri, b""))


def s3_write(path: str, data: bytes) -> None:
    bucket, key = _split_bucket_key(path)
    url, host, uri = _s3_url(bucket, key)
    _http("PUT", url, data=data,
          headers=lambda: _sigv4_headers("PUT", host, uri, data))


# -- gs:// -------------------------------------------------------------------

def _gs_endpoint() -> str:
    ep = os.environ.get("STORAGE_EMULATOR_HOST")
    if ep:
        if "://" not in ep:
            ep = "http://" + ep
        return ep.rstrip("/")
    return "https://storage.googleapis.com"


def _gs_headers() -> dict:
    tok = os.environ.get("GOOGLE_OAUTH_ACCESS_TOKEN")
    return {"Authorization": f"Bearer {tok}"} if tok else {}


def gs_read(path: str) -> bytes:
    bucket, key = _split_bucket_key(path)
    obj = urllib.parse.quote(key, safe="")
    url = (f"{_gs_endpoint()}/storage/v1/b/{bucket}/o/{obj}?alt=media")
    return _http("GET", url, headers=_gs_headers)


def gs_write(path: str, data: bytes) -> None:
    bucket, key = _split_bucket_key(path)
    name = urllib.parse.quote(key, safe="")
    url = (f"{_gs_endpoint()}/upload/storage/v1/b/{bucket}/o"
           f"?uploadType=media&name={name}")
    _http("POST", url, data=data,
          headers=lambda: {"Content-Type": "application/octet-stream",
                           **_gs_headers()})


# -- hdfs:// -----------------------------------------------------------------

def _webhdfs_base() -> str:
    base = os.environ.get("H2O_TPU_WEBHDFS")
    if not base:
        raise ValueError(
            "hdfs:// needs H2O_TPU_WEBHDFS (namenode HTTP address, "
            "e.g. http://namenode:9870)")
    return base.rstrip("/")


def _hdfs_path(path: str) -> str:
    # hdfs://nn/path and hdfs:///path both map to /path on the
    # configured namenode (the authority names the cluster, not a host
    # we contact directly — WebHDFS goes through H2O_TPU_WEBHDFS)
    rest = path[len("hdfs://"):]
    if rest.startswith("/"):
        p = rest
    else:
        p = "/" + rest.split("/", 1)[1] if "/" in rest else "/"
    return urllib.parse.quote(p, safe="/")


def hdfs_read(path: str) -> bytes:
    url = (f"{_webhdfs_base()}/webhdfs/v1{_hdfs_path(path)}?op=OPEN")
    # urllib follows the namenode->datanode redirect automatically
    return _http("GET", url)


class _NoRedirect(urllib.request.HTTPRedirectHandler):
    def redirect_request(self, *a, **k):
        return None


def hdfs_write(path: str, data: bytes) -> None:
    """WebHDFS two-step CREATE: PUT (no body) to the namenode, which
    307-redirects to a datanode; then PUT the data there.  urllib never
    follows redirects for PUT (and would drop the body if it did), so
    the dance is explicit.  Gateways/fakes that accept the create
    directly (2xx, no redirect) get the data in a second direct PUT."""
    url = (f"{_webhdfs_base()}/webhdfs/v1{_hdfs_path(path)}"
           f"?op=CREATE&overwrite=true")
    ct = {"Content-Type": "application/octet-stream"}
    from .runtime import faults, retry

    def create() -> str:
        """Namenode step: returns the datanode target (or `url` itself
        for direct-accepting gateways). Transients propagate to the
        whole-dance retry below — a namenode failover 503s for a few
        seconds."""
        opener = urllib.request.build_opener(_NoRedirect)
        req = urllib.request.Request(url, method="PUT")
        try:
            faults.fire("persist.http", method="PUT", url=url)
            with opener.open(req, timeout=60) as r:
                r.read()
            return url                # direct-accepting endpoint
        except urllib.error.HTTPError as e:
            if e.code in (301, 302, 307) and e.headers.get("Location"):
                return e.headers["Location"]
            body = e.read()[:300].decode(errors="replace")
            if e.code == 429 or e.code >= 500:
                raise retry.TransientError(
                    f"PUT {url} -> HTTP {e.code}: {body}",
                    retry_after=_retry_after(e)) from None
            # note: a 404 here is an IOError, not FileNotFoundError —
            # CREATE is a write; "the file isn't there yet" is its job
            raise IOError(
                f"PUT {url} -> HTTP {e.code}: {body}") from None
        except (TimeoutError, ConnectionError) as e:
            raise retry.TransientError(f"PUT {url} -> {e!r}") from None
        except urllib.error.URLError as e:
            raise retry.TransientError(
                f"PUT {url} -> {e.reason!r}") from None

    def dance() -> None:
        """One CREATE + data PUT. The data PUT gets a SINGLE attempt:
        a dead datanode must send the retry back through CREATE for a
        FRESH redirect target, not hammer the stale one."""
        target = create()
        _http("PUT", target, data=data, headers=ct,
              policy=retry.RetryPolicy(attempts=1))

    retry.call(dance, describe=f"hdfs CREATE+PUT {url}")


def register(schemes: dict) -> None:
    schemes["s3"] = (s3_read, s3_write)
    schemes["gs"] = (gs_read, gs_write)
    schemes["gcs"] = (gs_read, gs_write)
    schemes["hdfs"] = (hdfs_read, hdfs_write)
