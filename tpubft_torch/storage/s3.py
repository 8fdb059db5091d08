"""S3 wire-protocol object store (a copy of tpubft/storage/s3.py).

Rebuild of the reference's S3 client
(concord-bft storage/src/s3/client.cpp, libs3-based, consumed by the
read-only replica for ledger archival): an `IObjectStore` speaking the
S3 REST API over HTTP — PUT/GET/HEAD/DELETE object plus ListObjectsV2 —
with AWS Signature Version 4 request signing, against any S3-compatible
endpoint (AWS, MinIO, or the in-repo test server,
`tpubft_torch.testing.s3server`).

The integrity model of the archival layer (sha256 seal per object,
`objectstore._seal/_unseal`) is preserved on top of the wire protocol:
a corrupted object read returns None exactly like the filesystem
backend, so `ReadOnlyReplica` consumes either interchangeably.

Connections are pooled per thread (http.client keep-alive); transient
transport errors retry once with a fresh connection — the reference
client's retry-on-broken-connection behavior.
"""
from __future__ import annotations

import datetime
import hashlib
import hmac
import http.client
import threading
import urllib.parse
from typing import Iterator, Optional
from xml.etree import ElementTree

from tpubft_torch.storage.objectstore import (IObjectStore, _seal,
                                              _unseal)

_ALGO = "AWS4-HMAC-SHA256"


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def sigv4_headers(method: str, host: str, path: str, query: str,
                  payload: bytes, access_key: str, secret_key: str,
                  region: str = "us-east-1", service: str = "s3",
                  now: Optional[datetime.datetime] = None) -> dict:
    """AWS Signature Version 4 for one request (the auth scheme every
    S3-compatible store speaks). Returns the headers to attach.
    Deterministic given `now` — the test server re-derives and compares.
    """
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")
    payload_hash = hashlib.sha256(payload).hexdigest()
    headers = {
        "host": host,
        "x-amz-content-sha256": payload_hash,
        "x-amz-date": amz_date,
    }
    signed = ";".join(sorted(headers))
    canonical_qs = "&".join(sorted(query.split("&"))) if query else ""
    canonical = "\n".join([
        method,
        urllib.parse.quote(path, safe="/-_.~"),
        canonical_qs,
        "".join(f"{k}:{headers[k].strip()}\n" for k in sorted(headers)),
        signed,
        payload_hash,
    ])
    scope = f"{datestamp}/{region}/{service}/aws4_request"
    to_sign = "\n".join([
        _ALGO, amz_date, scope,
        hashlib.sha256(canonical.encode()).hexdigest(),
    ])
    k = _hmac(_hmac(_hmac(_hmac(("AWS4" + secret_key).encode(), datestamp),
                          region), service), "aws4_request")
    signature = hmac.new(k, to_sign.encode(), hashlib.sha256).hexdigest()
    headers["authorization"] = (
        f"{_ALGO} Credential={access_key}/{scope}, "
        f"SignedHeaders={signed}, Signature={signature}")
    return headers


class S3Error(Exception):
    pass


class S3ObjectStore(IObjectStore):
    """S3-REST `IObjectStore`. `endpoint` is "host:port" (plain HTTP —
    the reference's deployment terminates TLS in front; an https variant
    would swap HTTPSConnection in)."""

    def __init__(self, endpoint: str, bucket: str,
                 access_key: str = "", secret_key: str = "",
                 region: str = "us-east-1", prefix: str = "",
                 timeout_s: float = 10.0):
        self._endpoint = endpoint
        self._bucket = bucket
        self._access, self._secret = access_key, secret_key
        self._region = region
        self._prefix = prefix
        self._timeout = timeout_s
        self._local = threading.local()

    # ---- transport ----
    def _conn(self, fresh: bool = False) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None or fresh:
            if conn is not None:
                conn.close()
            conn = http.client.HTTPConnection(self._endpoint,
                                              timeout=self._timeout)
            self._local.conn = conn
        return conn

    def _request(self, method: str, key: str, query: str = "",
                 body: bytes = b""):
        # sigv4_headers canonicalizes (quotes) the RAW path itself —
        # passing a pre-quoted path would double-encode the signature
        raw_path = "/" + (f"{self._bucket}/{self._prefix}{key}" if key
                          else self._bucket)
        headers = sigv4_headers(method, self._endpoint, raw_path, query,
                                body, self._access, self._secret,
                                self._region)
        if body:
            headers["content-length"] = str(len(body))
        url = (urllib.parse.quote(raw_path, safe="/-_.~")
               + ("?" + query if query else ""))
        for attempt in (0, 1):      # one retry on a broken keep-alive conn
            conn = self._conn(fresh=attempt > 0)
            try:
                conn.request(method, url, body=body or None,
                             headers=headers)
                resp = conn.getresponse()
                data = resp.read()
                return resp.status, data
            except (http.client.HTTPException, OSError):
                if attempt:
                    raise
        raise AssertionError("unreachable")

    # ---- IObjectStore ----
    def put(self, key: str, data: bytes) -> None:
        status, body = self._request("PUT", key, body=_seal(data))
        if status not in (200, 201, 204):
            raise S3Error(f"PUT {key}: HTTP {status} {body[:200]!r}")

    def get(self, key: str) -> Optional[bytes]:
        status, body = self._request("GET", key)
        if status == 404:
            return None
        if status != 200:
            raise S3Error(f"GET {key}: HTTP {status}")
        return _unseal(body)

    def exists(self, key: str) -> bool:
        status, _ = self._request("HEAD", key)
        if status in (200,):
            return True
        if status in (404,):
            return False
        raise S3Error(f"HEAD {key}: HTTP {status}")

    def delete(self, key: str) -> None:
        status, _ = self._request("DELETE", key)
        if status not in (200, 204, 404):
            raise S3Error(f"DELETE {key}: HTTP {status}")

    def list(self, prefix: str = "") -> Iterator[str]:
        """ListObjectsV2 with continuation tokens."""
        token = None
        out = []
        while True:
            q = ("list-type=2&prefix="
                 + urllib.parse.quote(self._prefix + prefix, safe=""))
            if token:
                q += "&continuation-token=" + urllib.parse.quote(token,
                                                                 safe="")
            status, body = self._request("GET", "", query=q)
            if status != 200:
                raise S3Error(f"LIST: HTTP {status}")
            root = ElementTree.fromstring(body)
            ns = ""
            if root.tag.startswith("{"):
                ns = root.tag[:root.tag.index("}") + 1]
            for el in root.iter(f"{ns}Key"):
                k = el.text or ""
                if k.startswith(self._prefix):
                    out.append(k[len(self._prefix):])
            trunc = root.find(f"{ns}IsTruncated")
            if trunc is not None and (trunc.text or "").lower() == "true":
                tok = root.find(f"{ns}NextContinuationToken")
                token = tok.text if tok is not None else None
                if not token:
                    break
            else:
                break
        return iter(sorted(out))
