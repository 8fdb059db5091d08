"""Object store for read-only-replica ledger archival (a copy of
tpubft/storage/objectstore.py).

Rebuild of the reference's S3/object-store layer
(concord-bft storage/src/s3/client.cpp, consumed by the read-only
replica for ledger archival with integrity checks): a flat key→blob
store with S3-ish semantics (put/get/exists/delete/list-by-prefix).

Integrity model: every object is stored as sha256(data) || data, and
`get` verifies the digest before returning — a corrupted or truncated
object read returns None instead of poisoning the reader (the reference
performs the analogous checksum validation on its archival reads). The
filesystem backend writes atomically (tmp + rename) so a crash can't
leave a half-written object that passes existence checks.
"""
from __future__ import annotations

import abc
import hashlib
import os
import tempfile
from typing import Dict, Iterator, Optional


class IObjectStore(abc.ABC):
    @abc.abstractmethod
    def put(self, key: str, data: bytes) -> None: ...

    @abc.abstractmethod
    def get(self, key: str) -> Optional[bytes]:
        """None if absent OR integrity-corrupt."""

    @abc.abstractmethod
    def exists(self, key: str) -> bool: ...

    @abc.abstractmethod
    def delete(self, key: str) -> None: ...

    @abc.abstractmethod
    def list(self, prefix: str = "") -> Iterator[str]: ...


def _seal(data: bytes) -> bytes:
    return hashlib.sha256(data).digest() + data


def _unseal(blob: Optional[bytes]) -> Optional[bytes]:
    if blob is None or len(blob) < 32:
        return None
    digest, data = blob[:32], blob[32:]
    if hashlib.sha256(data).digest() != digest:
        return None
    return data


class InMemoryObjectStore(IObjectStore):
    """Test double (the reference's tests run against a fake S3)."""

    def __init__(self) -> None:
        self._objs: Dict[str, bytes] = {}

    def put(self, key: str, data: bytes) -> None:
        self._objs[key] = _seal(data)

    def get(self, key: str) -> Optional[bytes]:
        return _unseal(self._objs.get(key))

    def exists(self, key: str) -> bool:
        return key in self._objs

    def delete(self, key: str) -> None:
        self._objs.pop(key, None)

    def list(self, prefix: str = "") -> Iterator[str]:
        return iter(sorted(k for k in self._objs if k.startswith(prefix)))

    def corrupt(self, key: str) -> None:
        """Test hook: flip a byte so integrity verification must fail."""
        blob = bytearray(self._objs[key])
        blob[-1] ^= 0xFF
        self._objs[key] = bytes(blob)


class FsObjectStore(IObjectStore):
    """Directory-backed store; '/' in keys maps to subdirectories."""

    def __init__(self, root: str) -> None:
        self._root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        root = os.path.abspath(self._root)
        path = os.path.abspath(os.path.join(root, key))
        if path != root and not path.startswith(root + os.sep):
            raise ValueError(f"key escapes store root: {key!r}")
        return path

    def put(self, key: str, data: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(_seal(data))
            os.replace(tmp, path)       # atomic: never a torn object
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def get(self, key: str) -> Optional[bytes]:
        try:
            with open(self._path(key), "rb") as f:
                return _unseal(f.read())
        except OSError:
            return None

    def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def delete(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except OSError:
            pass

    def list(self, prefix: str = "") -> Iterator[str]:
        out = []
        for dirpath, _, files in os.walk(self._root):
            for fn in files:
                rel = os.path.relpath(os.path.join(dirpath, fn), self._root)
                key = rel.replace(os.sep, "/")
                if key.startswith(prefix):
                    out.append(key)
        return iter(sorted(out))
