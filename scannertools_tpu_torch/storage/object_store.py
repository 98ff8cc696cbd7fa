"""Remote object-store clients for the Files storage backend.

Reference parity: every C++ source/sink constructs a storehouse
``StorageBackend`` from (storage_type, bucket, region, endpoint) kwargs and
supports posix/gcs/s3 uniformly (files_source.cpp:122-165). This module
provides the gcs/s3 halves over plain HTTP — no SDK dependencies:

  * ``S3Client`` — S3 REST API with from-scratch AWS Signature V4 request
    signing (hashlib/hmac only). ``endpoint`` overrides the host for
    S3-compatible stores (minio, GCS interop, and the in-process test
    server).
  * ``GCSClient`` — GCS JSON/upload API with a bearer token from
    ``GOOGLE_OAUTH_ACCESS_TOKEN`` (or anonymous for public buckets);
    ``endpoint`` overrides the host for tests.

Both are small deliberately: get/put/exists/delete per key is the entire
surface the Files source/sink contract needs. The transport
(``urllib.request``) is injectable via the ``opener`` argument so tests can
run hermetic in a zero-egress image.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import os
import urllib.error
import urllib.parse
import urllib.request
from typing import Optional


class ObjectStoreError(IOError):
    pass


def _http(opener, method: str, url: str, headers: dict,
          body: Optional[bytes]) -> tuple:
    req = urllib.request.Request(url, data=body, method=method)
    for k, v in headers.items():
        req.add_header(k, v)
    open_fn = opener or urllib.request.urlopen
    try:
        with open_fn(req) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


class S3Client:
    """S3 REST client with AWS SigV4 signing (path-style addressing, which
    every S3-compatible endpoint accepts)."""

    def __init__(self, bucket: str, region: Optional[str] = None,
                 endpoint: Optional[str] = None,
                 access_key: Optional[str] = None,
                 secret_key: Optional[str] = None,
                 session_token: Optional[str] = None,
                 opener=None):
        self.bucket = bucket
        self.region = region or os.environ.get("AWS_REGION", "us-east-1")
        self.endpoint = (endpoint or
                         f"https://s3.{self.region}.amazonaws.com").rstrip("/")
        self.access_key = access_key or os.environ.get("AWS_ACCESS_KEY_ID", "")
        self.secret_key = secret_key or os.environ.get(
            "AWS_SECRET_ACCESS_KEY", "")
        self.session_token = session_token or os.environ.get(
            "AWS_SESSION_TOKEN")
        self._opener = opener

    # ------------------------------------------------------------- sigv4
    def _sign(self, method: str, key: str, body: bytes,
              now: Optional[datetime.datetime] = None) -> tuple:
        now = now or datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")
        host = urllib.parse.urlparse(self.endpoint).netloc
        path = "/" + urllib.parse.quote(f"{self.bucket}/{key}", safe="/~")
        payload_hash = hashlib.sha256(body or b"").hexdigest()

        headers = {
            "host": host,
            "x-amz-content-sha256": payload_hash,
            "x-amz-date": amz_date,
        }
        if self.session_token:
            headers["x-amz-security-token"] = self.session_token
        signed = ";".join(sorted(headers))
        canonical = "\n".join([
            method, path, "",
            "".join(f"{k}:{headers[k]}\n" for k in sorted(headers)),
            signed, payload_hash,
        ])
        scope = f"{datestamp}/{self.region}/s3/aws4_request"
        to_sign = "\n".join([
            "AWS4-HMAC-SHA256", amz_date, scope,
            hashlib.sha256(canonical.encode()).hexdigest(),
        ])

        def hm(k, msg):
            return hmac.new(k, msg.encode(), hashlib.sha256).digest()

        k = hm(("AWS4" + self.secret_key).encode(), datestamp)
        k = hm(k, self.region)
        k = hm(k, "s3")
        k = hm(k, "aws4_request")
        sig = hmac.new(k, to_sign.encode(), hashlib.sha256).hexdigest()
        headers["Authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
            f"SignedHeaders={signed}, Signature={sig}"
        )
        del headers["host"]  # urllib sets it from the URL
        return self.endpoint + path, headers

    # --------------------------------------------------------------- api
    def get(self, key: str) -> bytes:
        url, headers = self._sign("GET", key, b"")
        status, data = _http(self._opener, "GET", url, headers, None)
        if status != 200:
            raise ObjectStoreError(
                f"s3 GET {self.bucket}/{key}: HTTP {status}")
        return data

    def put(self, key: str, data: bytes) -> None:
        url, headers = self._sign("PUT", key, data)
        status, body = _http(self._opener, "PUT", url, headers, data)
        if status not in (200, 201):
            raise ObjectStoreError(
                f"s3 PUT {self.bucket}/{key}: HTTP {status}")

    def exists(self, key: str) -> bool:
        url, headers = self._sign("HEAD", key, b"")
        status, _ = _http(self._opener, "HEAD", url, headers, None)
        return status == 200

    def delete(self, key: str) -> None:
        url, headers = self._sign("DELETE", key, b"")
        _http(self._opener, "DELETE", url, headers, None)


class GCSClient:
    """GCS JSON API client (media download / simple upload)."""

    def __init__(self, bucket: str, endpoint: Optional[str] = None,
                 token: Optional[str] = None, opener=None):
        self.bucket = bucket
        self.endpoint = (endpoint or
                         "https://storage.googleapis.com").rstrip("/")
        self.token = token or os.environ.get("GOOGLE_OAUTH_ACCESS_TOKEN")
        self._opener = opener

    def _headers(self) -> dict:
        return {"Authorization": f"Bearer {self.token}"} if self.token else {}

    def _obj_url(self, key: str, media: bool) -> str:
        q = urllib.parse.quote(key, safe="")
        url = (f"{self.endpoint}/storage/v1/b/{self.bucket}/o/{q}")
        return url + "?alt=media" if media else url

    def get(self, key: str) -> bytes:
        status, data = _http(self._opener, "GET", self._obj_url(key, True),
                             self._headers(), None)
        if status != 200:
            raise ObjectStoreError(
                f"gcs GET {self.bucket}/{key}: HTTP {status}")
        return data

    def put(self, key: str, data: bytes) -> None:
        q = urllib.parse.quote(key, safe="")
        url = (f"{self.endpoint}/upload/storage/v1/b/{self.bucket}/o"
               f"?uploadType=media&name={q}")
        headers = dict(self._headers(),
                       **{"Content-Type": "application/octet-stream"})
        status, _ = _http(self._opener, "POST", url, headers, data)
        if status not in (200, 201):
            raise ObjectStoreError(
                f"gcs PUT {self.bucket}/{key}: HTTP {status}")

    def exists(self, key: str) -> bool:
        status, _ = _http(self._opener, "GET", self._obj_url(key, False),
                          self._headers(), None)
        return status == 200

    def delete(self, key: str) -> None:
        _http(self._opener, "DELETE", self._obj_url(key, False),
              self._headers(), None)


def make_client(storage_type: str, bucket: Optional[str],
                region: Optional[str], endpoint: Optional[str],
                opener=None):
    if storage_type == "s3":
        if not bucket:
            raise ValueError("s3 storage requires bucket=")
        return S3Client(bucket, region=region, endpoint=endpoint,
                        opener=opener)
    if storage_type == "gcs":
        if not bucket:
            raise ValueError("gcs storage requires bucket=")
        return GCSClient(bucket, endpoint=endpoint, opener=opener)
    raise ValueError(f"unknown storage_type {storage_type!r}")
