"""Tiny in-repo S3-compatible HTTP server (test double; a copy of
tpubft/testing/s3server.py).

The role of the reference's fake-S3 test setup (its S3 tests run against
a local MinIO/fake endpoint — bftengine/tests/s3): an in-memory
bucket store speaking the REST subset `S3ObjectStore` uses — PUT/GET/
HEAD/DELETE object and ListObjectsV2 with continuation tokens — and
*verifying* AWS SigV4 signatures when credentials are configured, so the
client's signing path is exercised end-to-end, not mocked out.

Usage:
    srv = S3TestServer(access_key="ak", secret_key="sk")
    srv.start()                      # serves on 127.0.0.1:<port>
    store = S3ObjectStore(srv.endpoint, "bucket", "ak", "sk")
"""
from __future__ import annotations

import datetime
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from xml.sax.saxutils import escape

from tpubft_torch.storage.s3 import sigv4_headers


class S3TestServer:
    def __init__(self, access_key: str = "", secret_key: str = "",
                 max_keys: int = 1000, port: int = 0):
        self._objs: Dict[str, bytes] = {}      # "bucket/key" -> raw blob
        self._lock = threading.Lock()
        self.access_key, self.secret_key = access_key, secret_key
        self.max_keys = max_keys
        self.fail_next = 0                      # test hook: N transport 500s
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):          # quiet
                pass

            def _deny(self, code: int, msg: str) -> None:
                body = msg.encode()
                self.send_response(code)
                self.send_header("content-length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _auth_ok(self, body: bytes) -> bool:
                if not outer.secret_key:
                    return True
                auth = self.headers.get("authorization", "")
                amz_date = self.headers.get("x-amz-date", "")
                if not auth or not amz_date:
                    return False
                try:
                    now = datetime.datetime.strptime(
                        amz_date, "%Y%m%dT%H%M%SZ").replace(
                            tzinfo=datetime.timezone.utc)
                except ValueError:
                    return False
                path, _, query = self.path.partition("?")
                path = urllib.parse.unquote(path)
                want = sigv4_headers(
                    self.command, self.headers.get("host", ""), path,
                    query, body, outer.access_key, outer.secret_key,
                    now=now)["authorization"]
                return want == auth

            def _object_key(self) -> str:
                path, _, _ = self.path.partition("?")
                return urllib.parse.unquote(path).lstrip("/")

            def _read_body(self) -> bytes:
                n = int(self.headers.get("content-length", "0") or 0)
                return self.rfile.read(n) if n else b""

            def _maybe_fail(self) -> bool:
                with outer._lock:
                    if outer.fail_next > 0:
                        outer.fail_next -= 1
                        return True
                return False

            def do_PUT(self):
                body = self._read_body()
                if self._maybe_fail():
                    return self._deny(500, "injected failure")
                if not self._auth_ok(body):
                    return self._deny(403, "SignatureDoesNotMatch")
                with outer._lock:
                    outer._objs[self._object_key()] = body
                self.send_response(200)
                self.send_header("content-length", "0")
                self.end_headers()

            def do_GET(self):
                body = self._read_body()
                if self._maybe_fail():
                    return self._deny(500, "injected failure")
                if not self._auth_ok(body):
                    return self._deny(403, "SignatureDoesNotMatch")
                path, _, query = self.path.partition("?")
                qs = urllib.parse.parse_qs(query)
                if "list-type" in qs:
                    return self._list(path.lstrip("/"), qs)
                with outer._lock:
                    blob = outer._objs.get(self._object_key())
                if blob is None:
                    return self._deny(404, "NoSuchKey")
                self.send_response(200)
                self.send_header("content-length", str(len(blob)))
                self.end_headers()
                self.wfile.write(blob)

            def do_HEAD(self):
                if not self._auth_ok(b""):
                    return self._deny(403, "SignatureDoesNotMatch")
                with outer._lock:
                    present = self._object_key() in outer._objs
                self.send_response(200 if present else 404)
                self.send_header("content-length", "0")
                self.end_headers()

            def do_DELETE(self):
                if not self._auth_ok(b""):
                    return self._deny(403, "SignatureDoesNotMatch")
                with outer._lock:
                    outer._objs.pop(self._object_key(), None)
                self.send_response(204)
                self.send_header("content-length", "0")
                self.end_headers()

            def _list(self, bucket: str, qs) -> None:
                prefix = qs.get("prefix", [""])[0]
                after = qs.get("continuation-token", [""])[0]
                full_prefix = f"{bucket}/{prefix}"
                with outer._lock:
                    keys = sorted(
                        k[len(bucket) + 1:] for k in outer._objs
                        if k.startswith(full_prefix))
                keys = [k for k in keys if k > after] if after else keys
                page, rest = keys[:outer.max_keys], keys[outer.max_keys:]
                parts = ["<?xml version='1.0'?><ListBucketResult>"]
                parts += [f"<Contents><Key>{escape(k)}</Key></Contents>"
                          for k in page]
                parts.append(
                    f"<IsTruncated>{'true' if rest else 'false'}"
                    "</IsTruncated>")
                if rest:
                    parts.append(f"<NextContinuationToken>"
                                 f"{escape(page[-1])}"
                                 f"</NextContinuationToken>")
                parts.append("</ListBucketResult>")
                body = "".join(parts).encode()
                self.send_response(200)
                self.send_header("content-type", "application/xml")
                self.send_header("content-length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def endpoint(self) -> str:
        host, port = self._server.server_address[:2]
        return f"{host}:{port}"

    def start(self) -> "S3TestServer":
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="s3-test-server")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    def corrupt(self, bucket_key: str) -> None:
        """Flip a byte of a stored object (integrity seal must catch it)."""
        with self._lock:
            blob = bytearray(self._objs[bucket_key])
            blob[-1] ^= 0xFF
            self._objs[bucket_key] = bytes(blob)

    def __enter__(self) -> "S3TestServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
